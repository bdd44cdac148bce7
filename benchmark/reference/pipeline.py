"""Plain float32 reference of the two paths the benchmark times: diffusers'
StableVideoDiffusionPipeline (exact: CLIP and the VAE's conditioning encode,
the EDM Euler sampler with its per-frame CFG guidance, the chunked temporal
decode) and the 'temporal' finetune step of SVD_Xtend's train_svd.py (the
frozen encodes, the conditioning dropout, the weighted EDM loss, the f32
global-norm clip and AdamW). It imports nothing of the program; the
networks are ``svd.py``'s."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from . import svd


def karras_sigmas(steps: int, sigma_min: float, sigma_max: float, rho: float = 7.0):
    """Descending Karras sigmas in f32 with a terminal 0."""
    ramp = torch.linspace(0.0, 1.0, steps, dtype=torch.float32)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    return torch.cat([(hi + ramp * (lo - hi)) ** rho, torch.zeros(1)])


def clip_embeds(nets, cfg, images):
    """CLIP's image embedding (N, 1, D) of [-1, 1] images, as the pipeline
    conditions on it."""
    fx = cfg["feature_extractor"]
    pixels = svd.clip_pixels(images, cfg["image_encoder"], fx["image_mean"], fx["image_std"])
    return nets["clip"](pixels)[:, None]


@torch.no_grad()
def sample(nets: Dict[str, torch.nn.Module], cfg: dict, pipe: dict, image, image_noise,
           latent_noise) -> torch.Tensor:
    """The sampler's final latents (1, F, h, w, 4) of one video: image (1, H,
    W, 3) in [-1, 1], unit-normal noise of the image and of the latents. The
    CFG pair is one batch of two, [uncond, cond], as diffusers stacks it."""
    unet, vae = nets["unet"], nets["vae"]
    embeds = clip_embeds(nets, cfg, image)
    aug = pipe["noise_aug_strength"]
    cond = vae.encode(image + aug * image_noise)[0]                         # (1, h, w, 4)
    f = pipe["num_frames"]
    cond = cond[:, None].expand(-1, f, -1, -1, -1)
    cond = torch.cat([torch.zeros_like(cond), cond])
    embeds = torch.cat([torch.zeros_like(embeds), embeds])
    ids = torch.tensor([[pipe["fps"] - 1, pipe["motion_bucket_id"], aug]] * 2,
                       device=image.device, dtype=torch.float32)
    guidance = torch.linspace(pipe["min_guidance_scale"], pipe["max_guidance_scale"], f,
                              device=image.device).reshape(1, f, 1, 1, 1)
    sch = cfg["scheduler"]
    sigmas = karras_sigmas(pipe["num_inference_steps"], sch["sigma_min"], sch["sigma_max"])
    latents = latent_noise * sch["sigma_max"]
    for sigma, nxt in zip(sigmas[:-1].tolist(), sigmas[1:].tolist()):
        x = torch.cat([latents] * 2) / math.sqrt(sigma * sigma + 1.0)
        t = torch.full((2,), 0.25 * math.log(sigma), device=image.device)
        uncond, out = unet(torch.cat([x, cond], -1), t, embeds, ids).chunk(2)
        out = uncond + guidance * (out - uncond)
        denoised = out * (-sigma / math.sqrt(sigma * sigma + 1.0)) + latents / (sigma * sigma + 1.0)
        latents = latents + (latents - denoised) / sigma * (nxt - sigma)
    return latents


@torch.no_grad()
def decode(nets: Dict[str, torch.nn.Module], cfg: dict, pipe: dict, latents) -> torch.Tensor:
    """(1, F, h, w, 4) latents -> (1, F, H, W, 3) in [-1, 1], decoded
    decode_chunk_size frames at a time."""
    z = latents / cfg["vae"]["scaling_factor"]
    chunk = pipe["decode_chunk_size"]
    video = torch.cat([nets["vae"].decoder(z[:, i:i + chunk])
                       for i in range(0, z.shape[1], chunk)], dim=1)
    return video.clamp(-1.0, 1.0)


def generate(nets, cfg: dict, pipe: dict, image, image_noise, latent_noise) -> torch.Tensor:
    """One video, (1, F, H, W, 3) in [-1, 1]."""
    return decode(nets, cfg, pipe, sample(nets, cfg, pipe, image, image_noise, latent_noise))


def train_loss(nets, cfg: dict, train: dict, pixels, draws: dict, remat: bool = True):
    """The weighted EDM loss of one batch (B, F, H, W, 3) in [-1, 1] with
    its draws (the fields of the program's TrainDraws)."""
    unet, vae = nets["unet"], nets["vae"]
    b, f, hp, wp, _ = pixels.shape
    sf = cfg["vae"]["scaling_factor"]
    with torch.no_grad():
        mean, logvar = vae.encode(pixels.reshape(b * f, hp, wp, 3))
        latents = (mean + torch.exp(0.5 * logvar) * draws["latent_noise"]) * sf
        latents = latents.reshape(b, f, *latents.shape[1:])
        first = pixels[:, 0]
        noisy = first + draws["cond_sigma"][:, None, None, None] * draws["cond_pixel_noise"]
        mean, logvar = vae.encode(noisy)
        cond = mean + torch.exp(0.5 * logvar) * draws["cond_latent_noise"]
        embeds = clip_embeds(nets, cfg, first)
    p, u = train["conditioning_dropout_prob"], draws["dropout_u"]
    embeds = embeds * (u >= 2 * p).float()[:, None, None]
    cond = cond * (1.0 - ((u >= p) & (u < 3 * p)).float())[:, None, None, None]
    sigma = draws["sigma"].reshape(b, 1, 1, 1, 1)
    noisy = latents + draws["noise"] * sigma
    x = torch.cat([noisy / torch.sqrt(sigma * sigma + 1.0),
                   cond[:, None].expand(-1, f, -1, -1, -1)], dim=-1)
    ids = torch.stack([torch.full((b,), 7.0, device=pixels.device),
                       torch.full((b,), 127.0, device=pixels.device), draws["cond_sigma"]], 1)
    pred = unet(x, 0.25 * torch.log(draws["sigma"]), embeds, ids, remat=remat)
    denoised = pred * (-sigma / torch.sqrt(sigma * sigma + 1.0)) + noisy / (sigma * sigma + 1.0)
    weight = (1.0 + sigma * sigma) / (sigma * sigma)
    return (weight * (denoised - latents) ** 2).reshape(b, -1).mean(1).mean()


TEMPORAL_SCOPE = "temporal_transformer_block"


def trainable(unet: torch.nn.Module, mode: str) -> List[str]:
    """The UNet leaves a finetune of `mode` trains, by train_svd.py's own rule:
    'temporal' takes every parameter whose name contains
    ``temporal_transformer_block`` (the temporal transformer blocks alone),
    'full' every parameter."""
    names = [n for n, _ in unet.named_parameters()]
    if mode == "full":
        return names
    if mode == "temporal":
        return [n for n in names if TEMPORAL_SCOPE in n]
    raise ValueError(f"no reference rule for the scope {mode!r}")


def train_steps(nets, cfg: dict, train: dict, batches: Sequence, trainable: List[str]):
    """The first len(batches) steps from the networks' weights, training the
    UNet leaves `trainable`: per step the loss; after the first, each leaf's
    gradient as AdamW gets it (clipped); after the last, each leaf's change.
    Returns {"losses", "grad_norms", "change_norms"} (norms by leaf name)."""
    named = dict(nets["unet"].named_parameters())
    for net in nets.values():
        net.requires_grad_(False)
    params = [named[n].requires_grad_(True) for n in trainable]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = train["adam_beta1"], train["adam_beta2"]
    lr, wd, eps = train["learning_rate"], train["adam_weight_decay"], train["adam_epsilon"]
    losses, grad_norms = [], None
    for t, (pixels, draws) in enumerate(batches, start=1):
        loss = train_loss(nets, cfg, train, pixels, draws)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        losses.append(loss.item())
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        if norm.item() >= train["max_grad_norm"]:
            grads = [g / norm * train["max_grad_norm"] for g in grads]
        if t == 1:
            grad_norms = {n: g.norm().item() for n, g in zip(trainable, grads)}
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                p.mul_(1.0 - lr * wd)
                mi.mul_(b1).add_(g, alpha=1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (vi / (1.0 - b2 ** t)).sqrt_().add_(eps)
                p.addcdiv_(mi, denom, value=-lr / (1.0 - b1 ** t))
        del grads, loss
    change = {n: (p.detach() - s).norm().item() for n, p, s in zip(trainable, params, start)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
