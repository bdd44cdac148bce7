"""Times the host-bound paths alone, to compare two trees of the port on one
card: the exact ``generate`` at PipelineConfig() (512x320, 14 frames, 25
steps, bf16, seeded random weights), the same UNet with a Tracklet2Video
branch and 16 boxes, and the 'tracklet' train step (512x320x14, batch 1).
Each path: a warm-up, then the timed runs; the host milliseconds each UNet
call took to return (forward hooks, the time to issue a pass on a path that
the host bounds) beside the wall seconds.

Run from the root of the tree to time (its package is the one imported):

  python -m svd_xtend_tpu_torch.scripts.time_paths [--videos 5] [--steps 5]

Prints the card's name and power limit, then one JSON line per path:
{"path", "runs": seconds each, "median", "unet_host_ms": median per call}.
Only APIs that PR 12 and later trees share are used, so an older tree can
run a copy of this file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch

SEED = 0
TRACKLET_DIM, TRACKLET_HEADS, TRACKLET_BOXES, TRACKLET_GATE = 1024, 8, 16, 0.5


def _boxes(gen, b, f, n, device):
    """(b, f, n, 4) boxes in [0, 1] with x1 < x2, y1 < y2; a mask with about
    a quarter of the slots empty."""
    a = torch.rand(b, f, n, 4, generator=gen, device=device)
    boxes = torch.cat([torch.minimum(a[..., :2], a[..., 2:]),
                       torch.maximum(a[..., :2], a[..., 2:])], dim=-1)
    return boxes, (torch.rand(b, f, n, generator=gen, device=device) > 0.25).float()


class _UNetClock:
    """Host milliseconds from each UNet call's entry to its return."""

    def __init__(self, unet):
        self.ms, self._t = [], 0.0
        unet.register_forward_pre_hook(lambda *_: setattr(self, "_t", time.perf_counter()))
        unet.register_forward_hook(
            lambda *_: self.ms.append(1e3 * (time.perf_counter() - self._t)))


def _timed(path, run, n):
    run()
    torch.cuda.synchronize()
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def _report(path, secs, clock):
    host = statistics.median(clock.ms) if clock.ms else None
    print(json.dumps({"path": path, "runs": secs, "median": statistics.median(secs),
                      "unet_host_ms": host}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", type=int, default=5)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_paths needs a CUDA card")
    from svd_xtend_tpu_torch.core.config import PipelineConfig, TrainConfig, UNetConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, generate
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step)

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    models = SVDModels.create(device=dev, dtype=torch.bfloat16, generator=gen)
    cfg = PipelineConfig()
    image = torch.rand(1, cfg.height, cfg.width, 3, device=dev, generator=gen) * 2 - 1
    noise = lambda: torch.Generator(device=dev).manual_seed(SEED)
    clock = _UNetClock(models.unet)
    secs = _timed("generate", lambda: generate(models, image, cfg, generator=noise()),
                  args.videos)
    clock.ms = clock.ms[-len(clock.ms) * args.videos // (args.videos + 1):]
    _report("generate", secs, clock)

    tracklet = models.with_tracklet(TRACKLET_DIM, TRACKLET_HEADS, gate_init=TRACKLET_GATE,
                                    generator=torch.Generator(dev).manual_seed(SEED + 25))
    del models
    torch.cuda.empty_cache()
    boxes, mask = _boxes(gen, 1, cfg.num_frames, TRACKLET_BOXES, dev)
    clock = _UNetClock(tracklet.unet)
    secs = _timed("tracklet", lambda: generate(tracklet, image, cfg, generator=noise(),
                                               boxes=boxes, box_mask=mask), args.videos)
    clock.ms = clock.ms[-len(clock.ms) * args.videos // (args.videos + 1):]
    _report("tracklet", secs, clock)
    del tracklet
    torch.cuda.empty_cache()

    tcfg = TrainConfig(train_mode="tracklet", tracklet_dim=TRACKLET_DIM,
                       tracklet_gate_init=TRACKLET_GATE)
    ucfg = dataclasses.replace(UNetConfig(), tracklet_dim=TRACKLET_DIM,
                               tracklet_gate_init=TRACKLET_GATE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    models = SVDModels.create(ucfg, device=dev, dtype=torch.float32, generator=gen)
    state = create_train_state(tcfg, models)
    cast_frozen_to_compute(models, torch.bfloat16)
    step = make_train_step(models, tcfg)
    b, f = tcfg.per_device_batch_size, tcfg.num_frames
    boxes, mask = _boxes(gen, b, f, tcfg.max_boxes, dev)
    batch = {"pixel_values": torch.rand(b, f, tcfg.height, tcfg.width, 3, device=dev,
                                        generator=gen) * 2 - 1,
             "boxes": boxes, "box_mask": mask}
    draws = torch.Generator(device=dev).manual_seed(SEED + 27)
    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], batch, generator=draws)

    clock = _UNetClock(models.unet)
    secs = _timed("tracklet_step", one_step, args.steps)
    clock.ms = clock.ms[-len(clock.ms) * args.steps // (args.steps + 1):]
    _report("tracklet_step", secs, clock)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
