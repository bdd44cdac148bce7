"""Quality against speed for the approximate inference modes: the port of
the JAX package's ``scripts/eval_approx.py``.

Every mode (CFG cache k2 / k3, int8 W8A8, DeepCache and their mixes) is
generated from the same seeded weights, image and noise as the exact
pipeline, and scored against the exact video:

  - PSNR(approx, exact) over the [-1, 1] video (pixel drift);
  - the mean cosine between the per-frame CLIP embeddings of the approximate
    and the exact frames (semantic drift, on the pipeline's own CLIP tower);
  - the largest absolute difference;
  - ``utils/metrics.py::video_report`` (CLIP similarity to the conditioning
    image, temporal consistency, flicker) of each mode;
  - seconds per video (the best of ``--iters`` timed videos after one
    untimed one) for the speed axis.

The weights are random (seed 0): the drift between two modes of the same
weights is still exact, and it is what is measured.

    python -m svd_xtend_tpu_torch.scripts.eval_approx --out eval_approx.json
    python -m svd_xtend_tpu_torch.scripts.eval_approx --device cpu --smoke \\
        --only cfg_cache_k2,cfg_cache_k3,int8

``--phase generate`` saves each mode's video (``<mode>.npy``, f32) and its
timing (``timings.json``) under ``--videos``; ``--phase metrics`` scores
saved videos, on another machine if need be; ``all`` (the default) does
both in one process, the videos staying on the device. Every flag and
default is the JAX script's; ``--device`` (``cuda`` by default, without a
card it raises; ``cpu`` runs the kernels' plain versions) is the port's.
A mode that fails ends the run with its error: no mode is skipped. The
smoke models (TINY, two UNet levels) cannot run ``deep_n2_d2``
(DeepCache depth 2 needs three levels): ``--smoke`` needs ``--only``.

Randomness comes from ``torch.Generator``s seeded as the JAX script seeds
its keys: the weights from 0, the image from 1, each mode's noise from
111. The streams are torch's, not JAX's, so a video equals the JAX script's
only where its noise (and weights and image) are passed in (``main``'s
``models``, ``image`` and ``noise``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..diffusion.pipeline import generate

WEIGHT_SEED, IMAGE_SEED, NOISE_SEED = 0, 1, 111   # the JAX script's keys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="approximate modes against exact (PyTorch port)")
    ap.add_argument("--phase", choices=["all", "generate", "metrics"], default="all")
    ap.add_argument("--videos", default=os.path.join(tempfile.gettempdir(),
                                                     "eval_approx_videos"),
                    help="directory for the saved per-mode videos")
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--iters", type=int, default=2,
                    help="timing iterations per mode (first run excluded)")
    ap.add_argument("--smoke", action="store_true", help="tiny configs (CPU smoke)")
    ap.add_argument("--only", default=None,
                    help="comma-separated mode names to run (exact always kept)")
    ap.add_argument("--out", default=None, help="write the JSON table here")
    ap.add_argument("--device", default="cuda",
                    help="the card ('cuda', the default) or 'cpu' (the kernels' plain versions)")
    return ap.parse_args(argv)


def build(args, models=None):
    """(models, base config, conditioning image, [(mode, config)]): the
    networks are `models` where given, else seeded random ones on
    --device (TINY in f32 with --smoke, full size in bf16 otherwise)."""
    from ..core.config import TINY_CLIP, TINY_UNET, TINY_VAE, PipelineConfig
    from ..diffusion.pipeline import SVDModels

    if args.smoke:
        base = PipelineConfig(height=32, width=32, num_frames=2, num_inference_steps=3,
                              decode_chunk_size=2)
    else:
        base = PipelineConfig(height=args.height, width=args.width, num_frames=args.frames,
                              num_inference_steps=args.steps, decode_chunk_size=8)
    if models is None:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda and no CUDA card; --device cpu runs on the CPU")
        gen = torch.Generator(device).manual_seed(WEIGHT_SEED)
        if args.smoke:
            models = SVDModels.create(TINY_UNET, TINY_VAE, TINY_CLIP, device=device,
                                      dtype=torch.float32, generator=gen)
        else:
            models = SVDModels.create(device=device, dtype=torch.bfloat16, generator=gen)
    device = models.unet.conv_in.weight.device
    image = torch.rand((1, base.height, base.width, 3), device=device,
                       generator=torch.Generator(device).manual_seed(IMAGE_SEED)) * 2.0 - 1.0
    rep = lambda **kw: dataclasses.replace(base, **kw)
    int8 = dict(unet_quant="int8", vae_quant="int8")
    modes = [
        ("exact", base),
        ("cfg_cache_k2", rep(uncond_reuse_interval=2)),
        ("cfg_cache_k3", rep(uncond_reuse_interval=3)),
        ("int8", rep(**int8)),
        ("int8_cfg_k3", rep(**int8, uncond_reuse_interval=3)),
        # DeepCache modes (PipelineConfig.deep_cache_interval / _depth)
        ("deep_n2", rep(deep_cache_interval=2)),
        ("deep_n3", rep(deep_cache_interval=3)),
        ("deep_n2_d2", rep(deep_cache_interval=2, deep_cache_depth=2)),
        ("deep_n2_cfg_k3", rep(deep_cache_interval=2, uncond_reuse_interval=3)),
        ("deep_n2_int8_cfg_k3", rep(deep_cache_interval=2, uncond_reuse_interval=3, **int8)),
        # n = k = 3 aligns the two caches: steps i % 3 == 0 run the full
        # pair, the others a shallow cond half
        ("deep_n3_cfg_k3", rep(deep_cache_interval=3, uncond_reuse_interval=3)),
        ("deep_n3_int8_cfg_k3", rep(deep_cache_interval=3, uncond_reuse_interval=3, **int8)),
    ]
    if args.only:
        keep = set(args.only.split(","))
        modes = [m for m in modes if m[0] in keep or m[0] == "exact"]
    return models, base, image, modes


def _check_modes(models, modes) -> None:
    """Refuse, before any video, a mode these networks cannot run."""
    n_up = len(models.unet.config.block_out_channels)
    bad = [name for name, cfg in modes
           if cfg.deep_cache_interval > 1 and not 1 <= cfg.deep_cache_depth < n_up]
    if bad:
        raise ValueError(f"modes {bad}: DeepCache depth must be in [1, {n_up - 1}] for a UNet "
                         f"of {n_up} levels; leave them out with --only")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_generate(args, vdir, models=None, image=None,
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Generate and time each mode, save its video and timing under `vdir`;
    {mode: video on the device} of the modes generated here (a mode whose
    video and timing are already there is not run again). `image` replaces
    the seeded image and `noise` = (image_noise, latent_noise) the seeded
    draws of every mode (the JAX script gives every mode the same key)."""
    models, _, seeded, modes = build(args, models)
    _check_modes(models, modes)
    image = seeded if image is None else image
    device = image.device

    os.makedirs(vdir, exist_ok=True)
    timings_path = os.path.join(vdir, "timings.json")
    timings = {}
    if os.path.exists(timings_path):
        with open(timings_path) as f:
            timings = json.load(f)

    def run(cfg):
        if noise is not None:
            kw = dict(image_noise=noise[0], latent_noise=noise[1])
        else:
            kw = dict(generator=torch.Generator(device).manual_seed(NOISE_SEED))
        video = generate(models, image, cfg, **kw)
        _sync(device)
        return video

    np.save(os.path.join(vdir, "cond_image.npy"), image.float().cpu().numpy())
    videos = {}
    for name, cfg in modes:
        vpath = os.path.join(vdir, f"{name}.npy")
        if name in timings and os.path.exists(vpath):
            print(f"{name}: cached ({timings[name]['s_per_video']} s)", flush=True)
            continue
        video = run(cfg)
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            run(cfg)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        np.save(vpath, video.float().cpu().numpy())
        videos[name] = video
        timings[name] = {"s_per_video": round(dt, 3),
                         "frames_per_sec": round(cfg.num_frames / dt, 3)}
        # written after every mode: a later failure keeps the finished modes
        with open(timings_path, "w") as f:
            json.dump(timings, f, indent=1)
        print(f"{name:14s} {dt:.3f} s/video", flush=True)
    print(f"videos + timings in {vdir}", flush=True)
    return videos


@torch.no_grad()
def phase_metrics(args, vdir, models=None, videos: Optional[Dict[str, torch.Tensor]] = None
                  ) -> dict:
    """Drift and report metrics of each mode against the exact video, on the
    CLIP tower of `models` (by default the seeded networks, whose tower is
    the generate phase's); videos from `videos` where given, else the saved
    ones. The table {"operating_point", "modes"}, written to --out."""
    from ..utils import metrics as M

    models, base, image, modes = build(args, models)
    clip = models.clip
    device = next(clip.parameters()).device
    timings_path = os.path.join(vdir, "timings.json")
    timings = {}
    if os.path.exists(timings_path):
        with open(timings_path) as f:
            timings = json.load(f)
    cpath = os.path.join(vdir, "cond_image.npy")
    if os.path.exists(cpath):
        image = torch.from_numpy(np.load(cpath)).to(device)
    videos = videos or {}

    def embed(video):
        b, f = video.shape[:2]
        flat = video.reshape((b * f,) + video.shape[2:])
        # two frames a call, as the JAX script embeds them
        return torch.cat([M._embed_frames(clip, flat[i:i + 2]) for i in range(0, b * f, 2)])

    results = {}
    exact_video = exact_embed = None
    for name, _cfg in modes:
        row = dict(timings.get(name, {}))
        vpath = os.path.join(vdir, f"{name}.npy")
        if name in videos:
            video = videos[name].float()
        elif os.path.exists(vpath):
            video = torch.from_numpy(np.load(vpath)).to(device)
        else:
            if row:
                results[name] = row
            continue
        ev = embed(video)
        if name == "exact":
            exact_video, exact_embed = video, ev
        elif exact_video is not None:
            row["psnr_vs_exact_db"] = round(float(M.psnr(video, exact_video)[0]), 2)
            row["clip_cos_vs_exact"] = round(float((ev * exact_embed).sum(-1).mean()), 4)
            row["max_abs_err"] = round(float((video - exact_video).abs().max()), 4)
        rep = M.video_report(clip, image, video)
        row.update({k: round(float(v), 4) for k, v in rep.items()})
        results[name] = row
        print(f"{name:14s} " + "  ".join(f"{k}={v}" for k, v in row.items()), flush=True)

    table = {"operating_point": f"{base.width}x{base.height}x{base.num_frames}f "
                                f"{base.num_inference_steps}st",
             "modes": results}
    print("\n" + json.dumps(table, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    return table


def main(argv=None, models=None, image=None, noise=None) -> Optional[dict]:
    """Run the phases the flags ask for; `models`, `image` and `noise` (see
    ``phase_generate``) replace the seeded ones (the tests pass the JAX
    package's). Returns the metrics table, or None after --phase generate."""
    args = parse_args(argv)
    if args.phase == "all" and models is None:
        models = build(args)[0]          # one set of networks for both phases
    videos = {}
    if args.phase in ("all", "generate"):
        videos = phase_generate(args, args.videos, models, image, noise)
    if args.phase in ("all", "metrics"):
        return phase_metrics(args, args.videos, models, videos)
    return None


if __name__ == "__main__":
    main()
