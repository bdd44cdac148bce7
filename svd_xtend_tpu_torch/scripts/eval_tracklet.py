"""Does Tracklet2Video conditioning steer generation? The port of the JAX
package's ``scripts/eval_tracklet.py``.

Protocol (the JAX script's):
  1. Synthesize videos of a bright square moving along straight lanes over
     one textured background, every lane starting at the centre (so the
     first frame says nothing of the motion); ``boxes.npz`` holds the
     square's box per frame. Four lanes train; the two diagonals are held
     out.
  2. Overfit through the training CLI (``train/cli.py``): by default the
     backbone and the branch together (``--mode full``), or the branch alone
     on the frozen backbone (``--mode tracklet``); ``--two_phase`` first
     overfits the backbone without the branch, then trains the branch on it.
  3. Generate from the first frame with the TRUE boxes of a lane, NULL
     boxes (an all-zero mask) and WRONG boxes (the opposite lane); score
     each frame's motion map |frame - frame0| by the share of its energy
     inside the box and by the IoU of its thresholded mask with the box.
  4. A denoiser probe: the 'right' and 'left' lanes' latents noised at
     σ 2 and 8, denoised once with each lane's boxes; ``steer_margin`` > 0
     means the boxes pull the prediction toward their own lane.

    python -m svd_xtend_tpu_torch.scripts.eval_tracklet --out eval_tracklet.json
    python -m svd_xtend_tpu_torch.scripts.eval_tracklet --device cpu --steps 2 \\
        --infer_steps 2

Every flag and default is the JAX script's; ``--device`` (``cuda`` by
default, without a card it raises; ``cpu`` runs the kernels' plain
versions) is the port's. The networks are TINY in f32, as in the JAX
script; on the card their sites take the kernels that take f32 at their
shapes and the plain versions elsewhere. Randomness comes from
``torch.Generator``s seeded as the JAX script seeds its keys (the
evaluation networks from 0, each generation from 11, the probe's encodes
from 9 and its noise from 10; the data's background from numpy's seed 0,
as there): torch's streams, not JAX's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

H = W = 32
SQ = 10           # square side in pixels
FRAMES = 4        # frames per training sample == generated frames

TRAIN_KINDS = ["right", "left", "down", "up"]
HELD_OUT = ["diag", "antidiag"]
# wrong boxes: the opposite lane
WRONG = {"right": "left", "left": "right", "down": "up", "up": "down",
         "diag": "antidiag", "antidiag": "diag"}
EVAL_SEED, GENERATE_SEED, ENCODE_SEED, PROBE_NOISE_SEED = 0, 11, 9, 10
PROBE_SIGMAS = (2.0, 8.0)


def _traj_boxes(kind: str) -> np.ndarray:
    """(FRAMES, 4) normalized xyxy along a named straight-line lane; every
    lane starts at the image centre."""
    c0 = ((W - SQ) // 2, (H - SQ) // 2)
    lanes = {
        # centre -> (x1, y1) of the square's top-left corner, in pixels
        "right": (c0, (W - SQ - 2, c0[1])),
        "left": (c0, (2, c0[1])),
        "down": (c0, (c0[0], H - SQ - 2)),
        "up": (c0, (c0[0], 2)),
        "diag": (c0, (W - SQ - 2, H - SQ - 2)),
        "antidiag": (c0, (2, 2)),
    }
    (x0, y0), (x1, y1) = lanes[kind]
    out = np.zeros((FRAMES, 4), np.float32)
    for f in range(FRAMES):
        a = f / (FRAMES - 1)
        x = x0 + a * (x1 - x0)
        y = y0 + a * (y1 - y0)
        out[f] = [x / W, y / H, (x + SQ) / W, (y + SQ) / H]
    return out


def _render(boxes: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """(FRAMES, H, W, 3) uint8: a bright square on a fixed textured
    background."""
    bg = rng.randint(0, 60, (H, W, 3), np.uint8)
    vid = np.zeros((FRAMES, H, W, 3), np.uint8)
    for f in range(FRAMES):
        img = bg.copy()
        x1, y1, x2, y2 = (boxes[f] * [W, H, W, H]).astype(int)
        img[y1:y2, x1:x2] = [250, 240, 60]
        vid[f] = img
    return vid


def build_dataset(root: str, train_kinds, seed=0):
    """One ``video_<lane>`` folder per lane: its JPEG frames and boxes.npz,
    every video on the same background."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    bg_rng_state = rng.get_state()
    for kind in train_kinds:
        d = os.path.join(root, f"video_{kind}")
        os.makedirs(d, exist_ok=True)
        rng.set_state(bg_rng_state)        # the same background for every video:
        boxes = _traj_boxes(kind)          # only the boxes tell the motions apart
        vid = _render(boxes, rng)
        for f in range(FRAMES):
            Image.fromarray(vid[f]).save(os.path.join(d, f"{f:04d}.jpg"), quality=95)
        np.savez(os.path.join(d, "boxes.npz"), boxes=boxes[:, None, :])


def _cli_argv(data_root: str, out_dir: str, steps: int, lr: float, batch: int,
              device: str):
    """The flags both training runs share."""
    return [
        "--per_device_batch_size", str(batch),
        # no decoupled weight decay: with near-zero early gradients through
        # the gates, AdamW's decay only shrinks the branch
        "--adam_weight_decay", "0.0",
        "--base_folder", data_root, "--tiny_model",
        "--width", str(W), "--height", str(H), "--num_frames", str(FRAMES),
        "--max_boxes", "1", "--learning_rate", str(lr),
        "--lr_scheduler", "constant", "--lr_warmup_steps", "0",
        "--output_dir", out_dir, "--checkpointing_steps", str(steps),
        "--validation_steps", str(steps * 2), "--num_inference_steps", "2",
        "--mixed_precision", "no", "--remat", "none", "--num_workers", "2",
        "--seed", "7", "--max_train_steps", str(steps),
        "--conditioning_dropout_prob", "0.0", "--device", device,
    ]


def train(data_root: str, out_dir: str, steps: int, lr: float, dim: int,
          mode: str = "full", gate_init: float = 0.0, batch: int = 1,
          pretrain_unet: str = "", p_mean: float = 0.7, p_std: float = 1.6,
          device: str = "cuda"):
    """The tracklet overfit through the training CLI."""
    from ..train import cli
    argv = ["--p_mean", str(p_mean), "--p_std", str(p_std),
            "--tracklet_gate_init", str(gate_init),
            *_cli_argv(data_root, out_dir, steps, lr, batch, device),
            "--train_mode", mode, "--tracklet_dim", str(dim)]
    if mode == "full":
        # the backbone and the branch together: the train lanes share one
        # first frame, so only the boxes separate them
        argv.append("--tracklet_dim_full")
    if pretrain_unet:
        argv += ["--pretrain_unet", pretrain_unet]
    cli.main(argv)


def load_models_and_params(out_dir: str, dim: int, device: str = "cuda"):
    """The TINY networks (f32, seeded 0) with the run's UNet and its
    Tracklet2Video branch loaded; prints the gate alphas as the JAX script
    does. Returns (models, {gate path: alpha})."""
    from ..core.config import TINY_CLIP, TINY_UNET, TINY_VAE
    from ..diffusion.pipeline import SVDModels
    from ..io import convert
    from ..io.safetensors_io import load_file
    from ..train.checkpoint import TRACKLET_FILE
    from .infer_svd import UNET_FILE

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA card; --device cpu runs on the CPU")
    models = SVDModels.create(TINY_UNET, TINY_VAE, TINY_CLIP, device=device,
                              dtype=torch.float32,
                              generator=torch.Generator(device).manual_seed(EVAL_SEED)
                              ).with_tracklet(dim)
    convert.load_unet_state(models.unet, convert.load_component_state(
        os.path.join(out_dir, "unet"), UNET_FILE))
    flat = load_file(os.path.join(out_dir, TRACKLET_FILE))
    convert.tracklet_branch_into_unet(flat, models.unet)
    gates = {k: float(v) for k, v in flat.items() if "alpha_" in k and v.numel() == 1}
    if gates:
        mags = [abs(g) for g in gates.values()]
        print(f"gate alphas: n={len(mags)} max|a|={max(mags):.4f} "
              f"mean|a|={float(np.mean(mags)):.4f}", flush=True)
    return models, gates


def adherence(video: np.ndarray, boxes: np.ndarray):
    """Mean inside-fraction and IoU of each frame's motion (f >= 1) against
    the box."""
    v = (video[0] + 1.0) / 2.0                       # (F, H, W, 3) in [0,1]
    motion = np.abs(v[1:] - v[:1]).mean(-1)          # (F-1, H, W)
    ins, ious = [], []
    for f in range(1, FRAMES):
        m = motion[f - 1]
        x1, y1, x2, y2 = (boxes[f] * [W, H, W, H]).astype(int)
        rect = np.zeros((H, W), bool)
        rect[y1:y2, x1:x2] = True
        tot = float(m.sum()) + 1e-8
        ins.append(float(m[rect].sum()) / tot)
        thr = m.mean() + m.std()
        mask = m > thr
        inter = float((mask & rect).sum())
        union = float((mask | rect).sum()) + 1e-8
        ious.append(inter / union)
    return float(np.mean(ins)), float(np.mean(ious))


def _lane_video(kind: str) -> np.ndarray:
    """(1, FRAMES, H, W, 3) f32 in [-1, 1]: a lane rendered on the data's
    background."""
    return _render(_traj_boxes(kind), np.random.RandomState(0)).astype(np.float32)[None] \
        / 127.5 - 1.0


def generations(models, kinds, infer_steps: int) -> Dict[str, dict]:
    """Each lane generated with its true, null and wrong boxes from its
    first frame, scored by ``adherence``: {lane: row}."""
    from ..core.config import PipelineConfig
    from ..diffusion.pipeline import generate

    device = models.unet.conv_in.weight.device
    cfg = PipelineConfig(height=H, width=W, num_frames=FRAMES, num_inference_steps=infer_steps,
                         decode_chunk_size=2, noise_aug_strength=0.0,
                         min_guidance_scale=1.0, max_guidance_scale=1.0)
    tensor = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    results = {}
    for kind in kinds:
        boxes = _traj_boxes(kind)
        image = tensor(_lane_video(kind)[:, 0])
        btrue = tensor(boxes)[None, :, None, :]                 # (1, F, 1, 4)
        mask1 = torch.ones((1, FRAMES, 1), device=device)
        bwrong = tensor(_traj_boxes(WRONG[kind]))[None, :, None, :]
        run = lambda b, m: generate(
            models, image, cfg, boxes=b, box_mask=m,
            generator=torch.Generator(device).manual_seed(GENERATE_SEED)).cpu().numpy()
        v_true = run(btrue, mask1)
        v_null = run(torch.zeros_like(btrue), torch.zeros_like(mask1))
        v_wrong = run(bwrong, mask1)
        row = {}
        for name, v in (("true", v_true), ("null", v_null), ("wrong", v_wrong)):
            ins, iou = adherence(v, boxes)
            row[name] = {"inside_frac": round(ins, 4), "iou": round(iou, 4)}
        # does the wrong-box video follow the WRONG boxes instead?
        ins_w, iou_w = adherence(v_wrong, _traj_boxes(WRONG[kind]))
        row["wrong_vs_its_own_boxes"] = {"inside_frac": round(ins_w, 4), "iou": round(iou_w, 4)}
        row["held_out"] = kind in HELD_OUT
        results[kind] = row
        print(f"{kind:10s} held_out={kind in HELD_OUT} "
              f"true={row['true']} null={row['null']} wrong={row['wrong']}", flush=True)
    return results


def probe_draws(models, mode: str, dim: int, generator: Optional[torch.Generator] = None):
    """The probe's encode draws for one lane video (the same for every lane,
    as the JAX script's one key) from `generator` (seeded ENCODE_SEED on the
    networks' device when not given)."""
    from ..diffusion.training import sample_train_draws
    device = models.unet.conv_in.weight.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(ENCODE_SEED)
    return sample_train_draws(models, (1, FRAMES, H, W, 3), _probe_config(mode, dim),
                              generator=generator, device=device)


def _probe_config(mode: str, dim: int):
    from ..core.config import TrainConfig
    return TrainConfig(train_mode=mode, tracklet_dim=dim, max_boxes=1,
                       conditioning_dropout_prob=0.0)


@torch.no_grad()
def denoiser_probe(models, lanes, mode: str, dim: int, draws=None,
                   noise: Optional[torch.Tensor] = None) -> dict:
    """Noise each lane's clean latents at σ 2 and 8, denoise once with each
    lane's boxes and score the prediction's MSE to every lane's clean
    latents; ``steer_margin@s<σ>`` > 0 when the boxes pull it toward their
    own lane. `draws` (``probe_draws``) and `noise` (the latents' shape)
    replace the seeded ones, the same for every lane and σ."""
    from ..core import edm
    from ..diffusion.pipeline import get_add_time_ids
    from ..diffusion.training import encode_batch

    device = models.unet.conv_in.weight.device
    tcfg = _probe_config(mode, dim)
    if draws is None:
        draws = probe_draws(models, mode, dim)
    enc = {k: encode_batch(models, torch.from_numpy(_lane_video(k)).to(device), tcfg, draws)
           for k in lanes}
    if noise is None:
        noise = torch.randn(enc[lanes[0]].latents.shape, device=device,
                            generator=torch.Generator(device).manual_seed(PROBE_NOISE_SEED))
    dt = models.dtype
    probe = {}
    for s in PROBE_SIGMAS:
        sigma = torch.tensor([s], device=device)
        sig_b = sigma.reshape(1, 1, 1, 1, 1)
        for src in lanes:
            e = enc[src]
            noisy = e.latents + noise * sig_b
            model_in = edm.precondition_inputs(noisy, sig_b)
            cond = e.cond_latents[:, None].expand(*e.latents.shape[:4],
                                                  e.cond_latents.shape[-1])
            model_in = torch.cat([model_in, cond], dim=-1)
            add_ids = get_add_time_ids(7.0, 127.0, 0.0, 1, device)
            add_ids[:, 2] = e.noise_aug.float()
            row = {}
            for cond_lane in lanes:
                bxp = torch.from_numpy(_traj_boxes(cond_lane)).to(device)[None, :, None, :]
                pred = models.unet(model_in.to(dt), edm.sigma_to_t(sigma),
                                   e.image_embeds.to(dt), add_ids, boxes=bxp,
                                   box_mask=torch.ones((1, FRAMES, 1), device=device))
                den = edm.denoise(pred.float(), noisy, sig_b)
                row[cond_lane] = {k2: round(float(((den - enc[k2].latents) ** 2).mean()), 5)
                                  for k2 in lanes}
            probe[f"noisy_{src}@s{s:g}"] = row
        # margin > 0: the conditioning pulls the prediction toward its own lane
        m = 0.0
        for src in lanes:
            row = probe[f"noisy_{src}@s{s:g}"]
            for cl in lanes:
                other = [k2 for k2 in lanes if k2 != cl][0]
                m += row[cl][other] - row[cl][cl]
        probe[f"steer_margin@s{s:g}"] = round(m / (len(lanes) ** 2), 6)
    probe["steer_margin"] = probe["steer_margin@s8"]
    return probe


def summarize(args, results: dict, probe: dict) -> dict:
    def _mean(sel, held):
        vals = [r[sel]["inside_frac"] for r in results.values() if r["held_out"] == held]
        return round(float(np.mean(vals)), 4)

    summary = {
        "steps": args.steps, "lr": args.lr, "dim": args.dim,
        "mode": args.mode, "gate_init": args.gate_init, "batch": args.batch,
        "denoiser_probe": probe,
        "train_inside_frac": {s: _mean(s, False) for s in ("true", "null", "wrong")},
        "held_out_inside_frac": {s: _mean(s, True) for s in ("true", "null", "wrong")},
    }
    for key, sel in (("steers_train", "train_inside_frac"),
                     ("steers_held_out", "held_out_inside_frac")):
        frac = summary[sel]
        summary[key] = frac["true"] > max(frac["null"], frac["wrong"])
    return summary


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Tracklet2Video box adherence (PyTorch port)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--mode", default="full", choices=["full", "tracklet"],
                    help="'full' = joint backbone+branch overfit (default); "
                         "'tracklet' = branch-only on the frozen backbone")
    ap.add_argument("--gate_init", type=float, default=0.5,
                    help="the gates' initial value for the joint overfit (0.0 is the "
                         "pretrained-backbone setting)")
    ap.add_argument("--infer_steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2, help="training batch size")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse an existing --workdir run")
    ap.add_argument("--two_phase", action="store_true",
                    help="phase 1: overfit the backbone without the branch; phase 2: "
                         "freeze it ('tracklet' scope) and train the gated branch from "
                         "--pretrain_unet")
    ap.add_argument("--steps1", type=int, default=6000,
                    help="phase-1 backbone steps (--two_phase)")
    ap.add_argument("--p2_mean", type=float, default=0.7,
                    help="phase-2 EDM sigma log-mean")
    ap.add_argument("--p2_std", type=float, default=1.6, help="phase-2 EDM sigma log-std")
    ap.add_argument("--device", default="cuda",
                    help="the card ('cuda', the default) or 'cpu' (the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Build the data, train (unless --skip_train finds the run), evaluate;
    returns {"summary", "per_trajectory"} and writes it to --out."""
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA card; --device cpu runs on the CPU")
    work = args.workdir or tempfile.mkdtemp(prefix="tracklet_eval_")
    data_root = os.path.join(work, "data")
    run_dir = os.path.join(work, "run")
    os.makedirs(data_root, exist_ok=True)
    build_dataset(data_root, TRAIN_KINDS)

    if not (args.skip_train
            and os.path.exists(os.path.join(run_dir, "tracklet_weights.safetensors"))):
        if args.two_phase:
            base_dir = os.path.join(work, "base")
            if not (args.skip_train and os.path.exists(os.path.join(base_dir, "unet"))):
                print(f"phase 1: {args.steps1} backbone-only steps...", flush=True)
                # the plain 'full' scope without the branch (no box conditioning)
                from ..train import cli
                cli.main([*_cli_argv(data_root, base_dir, args.steps1, args.lr, args.batch,
                                     args.device), "--train_mode", "full"])
            print(f"phase 2: {args.steps} branch-only steps on the frozen phase-1 "
                  "backbone...", flush=True)
            train(data_root, run_dir, args.steps, args.lr, args.dim, "tracklet",
                  args.gate_init, args.batch, pretrain_unet=os.path.join(base_dir, "unet"),
                  p_mean=args.p2_mean, p_std=args.p2_std, device=args.device)
        else:
            print(f"training {args.steps} steps (tiny model, {args.device}, mode="
                  f"{args.mode})...", flush=True)
            train(data_root, run_dir, args.steps, args.lr, args.dim, args.mode,
                  args.gate_init, args.batch, device=args.device)

    models, _ = load_models_and_params(run_dir, args.dim, args.device)
    results = generations(models, TRAIN_KINDS + HELD_OUT, args.infer_steps)
    lanes = ("right", "left") if "right" in results else tuple(results)[:2]
    probe = denoiser_probe(models, lanes, args.mode, args.dim)
    out = {"summary": summarize(args, results, probe), "per_trajectory": results}
    print(json.dumps(out["summary"], indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
