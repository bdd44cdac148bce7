"""The finetune step, steps back to back.

The traffic's ``train`` holds the program's TrainConfig fields. Set-up builds
one train step with its networks (f32 weights from the seed, the masters of
the trainable leaves taken from them, the frozen networks then cast to bf16,
as the CLI does) and one optimizer state, and hands that same step and state
to the window. A pool of ``pool`` batches is made from the seed before the
window (pixel videos, smooth in space and time, in [-1, 1], and every draw
of the step: posterior, noise-augmentation, dropout and EDM noise), all on
the device; step i takes pool[i % pool]. A step is done when its loss is in
host hands (the program reads it).

The first three steps are the set-up's warm-up and the ones checked: through
the window's own call, on pool[0], pool[1], pool[2]. The float32 reference
follows them from the same weights, batches and draws, training the leaves
that its own rule for the scope names (``reference.pipeline.trainable``).
Numbers compared:
  - scope_diff: the leaves that one side trains and the other does not;
  - loss_gap: the worst checked step's |loss - loss_ref| / |loss_ref|;
  - grad_gap: the first step's gradient as AdamW got it (clipped), read from
    the optimizer's first moment after one step (exp_avg / (1 - beta1)), by the
    worst leaf: | ||g|| - ||g_ref|| | / max(||g_ref||, the median leaf's);
  - update_gap: the masters' change over the three steps, by the worst leaf
    likewise, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (the others move by round-off alone).
A leaf the program does not train reads 0 on its side.
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F

from svd_xtend_tpu_torch.core.config import TrainConfig
from svd_xtend_tpu_torch.diffusion import training as port_training
from svd_xtend_tpu_torch.train import state as port_state

from .. import flops, spans, weights
from .. import program as program_build
from ..harness import Context, Outcome, Record, log, window
from ..reference import pipeline as ref_pipeline
from ..reference import svd

CHECKED = 3
PROFILED = 5


def batches(seed: int, tc: TrainConfig, cfg: dict, n: int, device):
    """`n` (pixels, draws) pairs; draws as a dict of the TrainDraws fields."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    b, f, hp, wp = tc.per_device_batch_size, tc.num_frames, tc.height, tc.width
    h, w = flops.latent_shape(cfg, hp, wp)
    lat = cfg["vae"]["latent_channels"]
    randn = lambda *s: torch.randn(s, generator=g, device=device)
    lognormal = lambda loc, scale: torch.exp(randn(b) * scale + loc)
    out = []
    for _ in range(n):
        coarse = torch.rand(b, 3, max(2, f // 4), max(2, hp // 32), max(2, wp // 32),
                            generator=g, device=device)
        pixels = F.interpolate(coarse * 2 - 1, size=(f, hp, wp), mode="trilinear",
                               align_corners=False).permute(0, 2, 3, 4, 1).contiguous()
        draws = {"latent_noise": randn(b * f, h, w, lat),
                 "cond_sigma": lognormal(tc.cond_aug_loc, tc.cond_aug_std),
                 "cond_pixel_noise": randn(b, hp, wp, 3),
                 "cond_latent_noise": randn(b, h, w, lat),
                 "dropout_u": torch.rand(b, generator=g, device=device),
                 "sigma": lognormal(tc.p_mean, tc.p_std),
                 "noise": randn(b, f, h, w, lat),
                 "box_dropout_u": torch.rand(b, generator=g, device=device)}
        out.append((pixels, draws))
    return out


def _gap(prog: dict, ref: dict, names) -> float:
    """The worst leaf's | ||prog|| - ||ref|| | over max(||ref||, the median
    leaf's ||ref||); a leaf missing from `prog` reads 0 there."""
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median) for n in names)


def loss_gap(prog: dict, ref: dict) -> float:
    """The largest of the checked steps' |loss - reference| / |reference|."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, from two sets of readings ({"losses",
    "grad_norms", "change_norms"}, as ``reference.pipeline.train_steps``
    returns them, norms by leaf name)."""
    names = list(ref["grad_norms"])
    median = statistics.median(ref["grad_norms"].values())
    moving = [n for n in names if ref["grad_norms"][n] >= 1e-3 * median]
    return {"scope_diff": float(len(set(names) ^ set(prog["change_norms"]))),
            "loss_gap": loss_gap(prog, ref),
            "grad_gap": _gap(prog["grad_norms"], ref["grad_norms"], names),
            "update_gap": _gap(prog["change_norms"], ref["change_norms"], moving)}


def program(cfg: dict, tc: TrainConfig, seed: int, device):
    """The program's networks, optimizer state and step, as the CLI builds them."""
    models = program_build.build_models(cfg, device, torch.float32, seed)
    state = port_state.create_train_state(tc, models)
    port_state.cast_frozen_to_compute(models, getattr(torch, cfg["dtype"]))
    return models, state, port_state.make_train_step(models, tc)


def checked_steps(one, state, tc: TrainConfig) -> dict:
    """Run the first CHECKED steps through `one(i)` (which returns the step's
    loss) and read the program's side of the check."""
    start = [p.detach().clone() for p in state.params]
    adamw = state.optimizer.adamw
    losses, grad_norms = [], {}
    for i in range(CHECKED):
        losses.append(one(i))
        if i == 0:
            st = adamw.state if adamw is not None else {}
            for n, p in zip(state.names, state.params):
                m = st.get(p, {}).get("exp_avg")
                grad_norms[n] = 0.0 if m is None else m.norm().item() / (1.0 - tc.adam_beta1)
    change = {n: (p.detach() - s).norm().item()
              for n, p, s in zip(state.names, state.params, start)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def reference(cfg: dict, train: dict, seed: int, pool, device, fp8: bool = False) -> dict:
    """The float32 reference's readings of the same CHECKED steps, over the
    leaves its own rule trains (with `fp8`, the reference in fp8 e4m3: the
    control)."""
    with torch.device("meta"):
        nets = svd.networks(cfg, svd.Num(fp8=fp8))
    for net in nets.values():
        net.to_empty(device=device)
    weights.fill_(weights.named_leaves(nets), seed)
    names = ref_pipeline.trainable(nets["unet"], train["train_mode"])
    with svd.f32_context():
        return ref_pipeline.train_steps(nets, cfg, train, pool[:CHECKED], names)


def run(ctx: Context) -> Outcome:
    cfg, dev = ctx.config, ctx.device
    tc = TrainConfig(**ctx.traffic["train"])
    log(ctx, "torch and the program imported")
    models, state, step = program(cfg, tc, ctx.seed, dev)
    log(ctx, "networks, weights and optimizer state built")
    pool = batches(ctx.seed, tc, cfg, ctx.traffic["pool"], dev)
    rec = Record("train", unit_flops=flops.train_step_flops(cfg, ctx.traffic["train"]))
    box = {"state": state}

    def one(i):
        pixels, draws = pool[i % len(pool)]
        box["state"], metrics = step(box["state"], pixels,
                                     draws=port_training.TrainDraws(**draws))
        return metrics["loss"]

    log(ctx, "batches made")
    prog = checked_steps(one, state, tc)
    del state
    if ctx.trace:
        rec.spans = spans.Spans(dev)
        rec.spans.on_module("unet.forward", models.unet)
    losses = []
    log(ctx, "set-up done")
    n = window(ctx, lambda i: losses.append(one(CHECKED + i)), rec)
    log(ctx, f"window done: {n} steps in {rec.window_s:.3f} s")
    if rec.spans is not None:
        rec.spans.remove()
        rec.span_units = n
    if ctx.trace and dev.type == "cuda":
        steps = lambda k0: [one(CHECKED + n + k0 + k) for k in range(PROFILED)]
        rec.profile = spans.profiled(lambda: steps(0), host=False)
        named = spans.profiled(lambda: steps(PROFILED))
        rec.profile["idle_gaps"] = named.get("idle_gaps", [])
        log(ctx, f"profiled: {PROFILED} steps in {rec.profile.get('window_s', 0):.3f} s on "
                 f"the device's clock, {named.get('window_s', 0):.3f} s with the host traced")
    finite = sum(1 for v in losses if math.isfinite(v))
    del models, box, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cfg, ctx.traffic["train"], ctx.seed, pool, dev)
    log(ctx, "reference done")
    return Outcome(rec, attempted=n, failed=n - finite, checks=compare(prog, ref))
