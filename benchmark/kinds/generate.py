"""Image-to-video generation, a closed loop with one client.

The traffic's ``pipeline`` holds the program's PipelineConfig fields (the
operating point). The client sends whole videos back to back; each video is
one request of a pool of ``pool`` requests made from the seed before the
window (an image, its noise-augmentation noise and the latents' initial
noise, all on the device), request i taking pool[i % pool]. A video is done
when the client holds it: its finiteness is read on the host.

Set-up: the networks from the seed (bf16, as served), then one video of two
sampler steps, which launches every shape of the cell (the CFG pair pass, the
encode, each decode chunk). The traced run adds the spans the per-layer
metrics read, and one more video under the profiler after the window.

Correctness, stage by stage from the program's own state (``check``): one
of the window's first CHECKABLE videos is drawn from the seed before the
window; the window keeps, by reference, what that video's UNet passes took
and returned, the latents its decode took and the video, and drops every
other video at once (a window too short to reach it runs it after its
close). The float32 reference (same weights, same request) judges each
stage of it:
  - start_rel_l2: the conditioning of the first pass (the CLIP embedding, the
    image's latent, the added time ids) against the reference's CLIP and VAE
    encode of the same image and noise;
  - pass_rel_l2: the worst of PASSES UNet passes drawn from the seed: the
    CFG pair's output against the reference UNet on the same input;
  - sampler_rel_l2: the worst step of the sampler: each pass's latents and
    timestep against the reference's EDM Euler step from the previous pass's
    latents and outputs (the first against the initial noise at sigma_max,
    the decode's latents against the last step);
  - decode_rel_l2: the video against the reference's chunked decode of the
    latents the program decoded.
Each is ||program - reference|| / ||reference|| (the timestep's gap relative
to |ln sigma|).
"""

from __future__ import annotations

import dataclasses
import math
import random

import torch
import torch.nn.functional as F

from svd_xtend_tpu_torch.core.config import PipelineConfig
from svd_xtend_tpu_torch.diffusion import pipeline as port_pipeline
from svd_xtend_tpu_torch.models import transformer as port_transformer

from .. import flops, program, spans, weights
from ..harness import Context, Outcome, Record, log, window
from ..reference import pipeline as ref_pipeline
from ..reference import svd

PASSES = 4
CHECKABLE = 2


def requests(seed: int, pipe: dict, cfg: dict, n: int, device):
    """`n` requests: a smooth image in [-1, 1] (random colours on a coarse
    grid, bilinear), the image's noise and the latents' noise."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    hp, wp, f = pipe["height"], pipe["width"], pipe["num_frames"]
    h, w = flops.latent_shape(cfg, hp, wp)
    lat = cfg["vae"]["latent_channels"]
    out = []
    for _ in range(n):
        coarse = torch.rand(1, 3, max(2, hp // 32), max(2, wp // 32), generator=g, device=device)
        image = F.interpolate(coarse * 2 - 1, size=(hp, wp), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1).contiguous()
        out.append({"image": image,
                    "image_noise": torch.randn(1, hp, wp, 3, generator=g, device=device),
                    "latent_noise": torch.randn(1, f, h, w, lat, generator=g, device=device)})
    return out


class Capture:
    """The checked video's UNet calls (sample, timestep, encoder states, time
    ids, output) and the latents its decode took, kept by reference: the
    program makes each of them afresh and writes none of them again. Other
    videos pass by untouched."""

    def __init__(self, models):
        self.video = None
        self._hook = models.unet.register_forward_hook(self._on_pass)
        self._decode = port_pipeline.decode_latents_chunked

        def decode(models_, latents, *a, **kw):
            if self.video is not None:
                self.video["latents"] = latents
            return self._decode(models_, latents, *a, **kw)

        port_pipeline.decode_latents_chunked = decode

    def _on_pass(self, module, args, out) -> None:
        if self.video is not None:
            self.video["passes"].append((*args[:4], out))

    def start(self) -> dict:
        """Keep what the next video takes and returns, in the dict returned."""
        self.video = {"passes": []}
        return self.video

    def stop(self) -> None:
        self.video = None

    def remove(self) -> None:
        self._hook.remove()
        port_pipeline.decode_latents_chunked = self._decode


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def sampler_gaps(cfg: dict, pipe: dict, passes, latent_noise, latents, fp8: bool = False):
    """Each step's gap between the program's sampler and the reference's EDM
    Euler step from the program's previous state; with `fp8`, the gaps a
    sampler that kept its latents in fp8 e4m3 would read (the control)."""
    sch = cfg["scheduler"]
    sigmas = ref_pipeline.karras_sigmas(pipe["num_inference_steps"], sch["sigma_min"],
                                        sch["sigma_max"]).tolist()
    f = pipe["num_frames"]
    guidance = torch.linspace(pipe["min_guidance_scale"], pipe["max_guidance_scale"], f,
                              device=latent_noise.device).reshape(1, f, 1, 1, 1)
    c_in = lambda s: 1.0 / math.sqrt(s * s + 1.0)
    fp8_round = svd.Num(fp8=True)
    got = lambda held, want: fp8_round(want) if fp8 else held
    want = latent_noise * sch["sigma_max"] * c_in(sigmas[0])
    gaps = []
    for i, (x, t, _, _, out) in enumerate(passes):
        gaps.append(rel(got(x[0:1, ..., :4], want), want))
        tt = torch.as_tensor(t, dtype=torch.float32).reshape(-1)[0].item()
        gaps.append(abs(tt - 0.25 * math.log(sigmas[i])) / abs(0.25 * math.log(sigmas[i])))
        s, nxt = sigmas[i], sigmas[i + 1]
        lat = x[0:1, ..., :4].float() / c_in(s)
        u, c = out[0:1].float(), out[1:2].float()
        denoised = (u + guidance * (c - u)) * (-s * c_in(s)) + lat / (s * s + 1.0)
        want = (lat + (lat - denoised) / s * (nxt - s)) * (c_in(nxt) if nxt > 0 else 1.0)
    gaps.append(rel(got(latents, want), want))
    return gaps


def check(nets, cfg: dict, pipe: dict, req: dict, cap: dict, video, rng: random.Random) -> dict:
    """The four numbers of one video (see the module's docstring)."""
    passes = cap["passes"]
    x0, _, ehs0, ids0, _ = passes[0]
    embeds = ref_pipeline.clip_embeds(nets, cfg, req["image"])
    aug = pipe["noise_aug_strength"]
    cond = nets["vae"].encode(req["image"] + aug * req["image_noise"])[0]
    ids = torch.tensor([pipe["fps"] - 1, pipe["motion_bucket_id"], aug], device=cond.device)
    start = max(rel(ehs0[1], embeds[0]), rel(x0[1, 0, ..., 4:], cond[0]), rel(ids0[1], ids))
    worst = 0.0
    for i in sorted(rng.sample(range(len(passes)), min(PASSES, len(passes)))):
        x, t, ehs, tids, out = passes[i]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(
            x.shape[0])
        worst = max(worst, rel(out, nets["unet"](x.float(), t, ehs.float(), tids.float())))
    sampler = max(sampler_gaps(cfg, pipe, passes, req["latent_noise"], cap["latents"]))
    decode = rel(video, ref_pipeline.decode(nets, cfg, pipe, cap["latents"].float()))
    return {"start_rel_l2": start, "pass_rel_l2": worst, "sampler_rel_l2": sampler,
            "decode_rel_l2": decode}


def reference_nets(cfg: dict, seed: int, device, fp8: bool = False) -> dict:
    """The reference's networks holding the weights the program serves (the
    law's values rounded to the configuration's dtype), in float32."""
    with torch.device("meta"):
        nets = svd.networks(cfg, svd.Num(fp8=fp8))
    for net in nets.values():
        net.to_empty(device=device)
    weights.fill_(weights.named_leaves(nets), seed, round_to=getattr(torch, cfg["dtype"]))
    return nets


def _instrument(sp: spans.Spans, models) -> None:
    sp.on_module("unet.pass", models.unet)
    sp.on_module("vae.decode", models.vae.decoder)
    for name, m in models.unet.named_modules():
        if name.endswith("attn1") and ".transformer_blocks." in name:
            heads = m.num_heads
            sp.on_module("bench.attn1", m, cost=lambda args, h=heads: flops.attn1_cost(
                args[0].shape[0], args[0].shape[1], args[0].shape[2], h))
    sp.on_function("bench.ff", port_transformer, "residual_geglu",
                   cost=lambda args: flops.ff_cost(args[0].numel() // args[0].shape[-1],
                                                   args[0].shape[-1]))


def run(ctx: Context) -> Outcome:
    cfg, pipe, dev = ctx.config, dict(ctx.traffic["pipeline"]), ctx.device
    pcfg = PipelineConfig(**pipe)
    models = program.build_models(cfg, dev, getattr(torch, cfg["dtype"]), ctx.seed)
    pool = requests(ctx.seed, pipe, cfg, ctx.traffic["pool"], dev)
    rec = Record("generate", unit_flops=flops.video_flops(cfg, pipe))

    def video(i, config=pcfg):
        r = pool[i % len(pool)]
        return port_pipeline.generate(models, r["image"], config, image_noise=r["image_noise"],
                                      latent_noise=r["latent_noise"])

    video(0, dataclasses.replace(pcfg, num_inference_steps=min(2, pcfg.num_inference_steps)))
    if ctx.trace:
        rec.spans = spans.Spans(dev)
        _instrument(rec.spans, models)
    finite, checked = [], {}
    cap = Capture(models)
    rng = random.Random(ctx.seed)
    pick = rng.randrange(CHECKABLE)

    def one(i):
        kept = cap.start() if i == pick else None
        v = video(i)
        cap.stop()
        finite.append(bool(torch.isfinite(v).all()))
        if kept is not None:
            checked.update(video=v, kept=kept)

    log(ctx, "set-up done")
    n = window(ctx, one, rec)
    log(ctx, f"window done: {n} videos in {rec.window_s:.3f} s")
    if not checked:
        kept = cap.start()
        checked.update(video=video(pick), kept=kept)
        cap.stop()
    cap.remove()
    if ctx.trace and dev.type == "cuda":
        rec.profile = spans.profiled(lambda: video(n))
    if rec.spans is not None:
        rec.spans.remove()
        rec.span_units = n + (1 if rec.profile else 0)
    got, kept = checked["video"], checked["kept"]
    del models, cap, checked
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    nets = reference_nets(cfg, ctx.seed, dev)
    log(ctx, f"reference built; checking video {pick}")
    with svd.f32_context(), torch.no_grad():
        checks = check(nets, cfg, pipe, pool[pick % len(pool)], kept, got, rng)
    log(ctx, "reference done")
    return Outcome(rec, attempted=n, failed=n - sum(finite), checks=checks)
