"""Image-to-video generation (the exact path of StableVideoDiffusionPipeline).

Port of ``svd_xtend_tpu/diffusion/pipeline.py``: CLIP-encode the image (+ a
zero embedding for CFG), VAE-encode the noise-augmented image (its UNSCALED
posterior mode is the conditioning latent), build added_time_ids =
[fps - fps_offset, motion_bucket_id, noise_aug_strength], start the latents
at sigma_max, run the Euler loop with the CFG pair stacked as one batch
interleaved [u0, c0, u1, c1, ...] and a per-frame linear guidance scale,
decode in chunks of frames (the last one may be ragged) and clip to [-1, 1].

The cache modes are ported with JAX's schedules (pipeline.py:318-450):
- the CFG cache (``uncond_reuse_interval`` k > 1): the stacked pair every
  k-th step, the cond half alone (batch b) in between, carrying the last
  uncond output;
- DeepCache (``deep_cache_interval`` n > 1, ``deep_cache_depth`` d): every
  n-th step the full pair, which also returns the deep feature
  (``models/unet.py``), the shallow pair around it in between;
- both: per-branch deep caches in the interleaved [u0, c0, ...] layout; an
  uncond-refresh step (i % k == 0) runs the full pair even off the
  DeepCache interval, a DeepCache step alone refreshes the cond trunk with a
  full cond-only pass, any other step is a shallow cond-only pass.
int8 (``unet_quant``/``vae_quant``) is refused; Tracklet2Video boxes are
not taken.

Randomness: ``generate`` takes a ``torch.Generator``; ``image_noise`` and
``latent_noise`` may be given explicitly instead (the tests feed the JAX
draws through them). Weights come from ``io/convert.state_dict_from_jax`` or
from ``init_random_``'s seeded flax-law initialisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..core.config import (CLIPVisionConfig, PipelineConfig, SchedulerConfig,
                           UNetConfig, VAEConfig)
from ..models.clip import CLIPVisionModelWithProjection, preprocess_for_clip
from ..models.unet import UNetSpatioTemporalConditionModel
from ..models.vae import AutoencoderKLTemporalDecoder
from .scheduler import EulerDiscreteScheduler

# flax lecun_normal: a normal truncated at two standard deviations, scaled so
# its variance is 1/fan_in (0.8796... is the std of the truncated unit normal)
_TRUNC_STD = 0.87962566103423978


def _truncated_normal_(p: torch.Tensor, std: float, generator: torch.Generator):
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
    p.uniform_(2.0 * cdf(-2.0) - 1.0, 2.0 * cdf(2.0) - 1.0, generator=generator)
    p.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the flax init laws the JAX package uses:
    lecun-normal kernels (fan-in = all but the output axis), zero biases,
    unit norm scales, normal(0.02) CLIP class/position embeddings;
    ``mix_factor`` keeps its constructor value. In place; returns module."""
    for name, p in module.named_parameters():
        if name.endswith("mix_factor"):
            continue
        if name.endswith(("class_embedding", "position_embedding.weight")):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = p.numel() // p.shape[0]
            _truncated_normal_(p, (1.0 / fan_in) ** 0.5 / _TRUNC_STD, generator)
    return module


@dataclasses.dataclass
class SVDModels:
    """The three networks and the scheduler of the pipeline."""

    unet: UNetSpatioTemporalConditionModel
    vae: AutoencoderKLTemporalDecoder
    clip: CLIPVisionModelWithProjection
    scheduler: EulerDiscreteScheduler = EulerDiscreteScheduler()

    @classmethod
    def create(cls, unet_config: UNetConfig = UNetConfig(),
               vae_config: VAEConfig = VAEConfig(),
               clip_config: CLIPVisionConfig = CLIPVisionConfig(),
               scheduler_config: SchedulerConfig = SchedulerConfig(), *,
               device=None, dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None) -> "SVDModels":
        """Build the networks on `device` (by default the card: without one
        this raises; pass ``device="cpu"`` to build on the CPU); with a
        generator, initialise them (in f32, on the device) from it, then cast
        to `dtype`."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("SVDModels.create builds on the CUDA device by "
                                   "default and none is available; pass device='cpu' "
                                   "to build on the CPU")
            device = "cuda"
        nets = []
        for build, cfg in ((UNetSpatioTemporalConditionModel, unet_config),
                           (AutoencoderKLTemporalDecoder, vae_config),
                           (CLIPVisionModelWithProjection, clip_config)):
            with torch.device(device):
                net = build(cfg)
            if generator is not None:
                init_random_(net, generator)
            nets.append(net.to(dtype).eval().requires_grad_(False))
        return cls(*nets, EulerDiscreteScheduler(scheduler_config))

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    def check_resolution(self, height: int, width: int) -> None:
        ds = self.vae.config.downsample_factor
        unet_div = ds * 2 ** (len(self.unet.config.block_out_channels) - 1)
        if height % unet_div or width % unet_div:
            raise ValueError(f"height/width must be divisible by {unet_div} "
                             f"(VAE {ds}x downsample x UNet levels); got {width}x{height}")


def encode_conditioning(models: SVDModels, image: torch.Tensor,
                        noise_aug_strength: float, image_noise: torch.Tensor):
    """CLIP embedding (B, 1, D) and the noise-augmented, UNSCALED
    first-frame VAE latent (B, h, w, latent) f32 (the posterior's mode)."""
    clip_in = preprocess_for_clip(image, models.clip.config)
    image_embeds = models.clip(clip_in)[:, None, :]
    noisy = image.float() + noise_aug_strength * image_noise.float()
    cond_latent = models.vae.encode(noisy.to(models.dtype)).mode()
    return image_embeds, cond_latent.float()


def get_add_time_ids(fps: float, motion_bucket_id: float, noise_aug_strength: float,
                     batch: int, device=None) -> torch.Tensor:
    """[fps, motion_bucket_id, noise_aug] per sample, (B, 3) f32."""
    row = torch.tensor([fps, motion_bucket_id, noise_aug_strength],
                       dtype=torch.float32, device=device)
    return row.expand(batch, 3).clone()


@torch.no_grad()
def decode_latents_chunked(models: SVDModels, latents: torch.Tensor,
                           decode_chunk_size: int) -> torch.Tensor:
    """(B, F, h, w, 4) scaled latents -> (B, F, H, W, 3) f32 pixels, decoded
    `decode_chunk_size` frames at a time. Chunks hold only real frames (the
    last may be shorter): the decoder's frame convs mix frames in a chunk."""
    z = latents / models.vae.config.scaling_factor
    f = z.shape[1]
    cap = min(decode_chunk_size, f)
    parts = [models.vae.decode(z[:, i:i + cap].to(models.dtype)).float()
             for i in range(0, f, cap)]
    return torch.cat(parts, dim=1)


def _cfg_stack(u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Interleave per sample: [u0, c0, u1, c1, ...]."""
    return torch.stack([u, c], dim=1).reshape((2 * u.shape[0],) + u.shape[1:])


def _cfg_unstack(x: torch.Tensor):
    r = x.reshape((-1, 2) + x.shape[1:])
    return r[:, 0], r[:, 1]


@torch.no_grad()
def generate(models: SVDModels, image: torch.Tensor,
             config: PipelineConfig = PipelineConfig(), *,
             generator: Optional[torch.Generator] = None,
             image_noise: Optional[torch.Tensor] = None,
             latent_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """img2vid: (B, H, W, 3) image in [-1, 1] -> (B, F, H, W, 3) f32 video
    in [-1, 1]. `image_noise` (B, H, W, 3) and `latent_noise`
    (B, F, H/8, W/8, latent) are unit normals; those not given are drawn
    from `generator`."""
    cfg = config
    if cfg.unet_quant is not None or cfg.vae_quant is not None:
        raise ValueError("int8 quantisation (unet_quant, vae_quant) is not ported")
    models.check_resolution(cfg.height, cfg.width)
    b, f = image.shape[0], cfg.num_frames
    device = image.device
    ds = models.vae.config.downsample_factor
    lat_c = models.vae.config.latent_channels
    h8, w8 = cfg.height // ds, cfg.width // ds
    if image_noise is None:
        image_noise = torch.randn(image.shape, generator=generator, device=device)
    if latent_noise is None:
        latent_noise = torch.randn((b, f, h8, w8, lat_c), generator=generator,
                                   device=device)

    image_embeds, cond_latent = encode_conditioning(
        models, image, cfg.noise_aug_strength, image_noise)
    add_ids = get_add_time_ids(cfg.fps - cfg.fps_offset, cfg.motion_bucket_id,
                               cfg.noise_aug_strength, b, device)
    ehs = _cfg_stack(torch.zeros_like(image_embeds), image_embeds)
    cond_lat = cond_latent[:, None].expand(b, f, h8, w8, lat_c)
    cond_lat2 = _cfg_stack(torch.zeros_like(cond_lat), cond_lat)
    add_ids2 = _cfg_stack(add_ids, add_ids)

    scheduler = models.scheduler
    sigmas = scheduler.sigmas(cfg.num_inference_steps)
    latents = latent_noise.float() * scheduler.init_noise_sigma()
    guidance = torch.linspace(cfg.min_guidance_scale, cfg.max_guidance_scale, f,
                              dtype=torch.float32, device=device).reshape(1, f, 1, 1, 1)
    k_reuse = max(1, cfg.uncond_reuse_interval)
    n_deep = max(1, cfg.deep_cache_interval)
    deep_kw = dict(cache_depth=cfg.deep_cache_depth)

    def unet_out(x_in, t, ehs_, ids_, **kw):
        out = models.unet(x_in.to(models.dtype), t, ehs_, ids_, **kw)
        if isinstance(out, tuple):               # return_deep: (out, deep)
            return out[0].float(), out[1]
        return out.float()

    def pair(latents, sigma, **kw):
        """The stacked (uncond, cond) batch of 2b: (uncond, cond[, deep2])."""
        x_in = scheduler.scale_model_input(_cfg_stack(latents, latents), sigma)
        x_in = torch.cat([x_in, cond_lat2], dim=-1)
        t = scheduler.timestep(sigma).to(device).expand(2 * b)
        out = unet_out(x_in, t, ehs, add_ids2, **kw)
        if isinstance(out, tuple):
            return (*_cfg_unstack(out[0]), out[1])
        return _cfg_unstack(out)

    def cond_half(latents, sigma, **kw):
        """The cond branch alone, batch b: cond[, deep]."""
        x_in = torch.cat([scheduler.scale_model_input(latents, sigma), cond_lat], dim=-1)
        t = scheduler.timestep(sigma).to(device).expand(b)
        return unet_out(x_in, t, image_embeds, add_ids, **kw)

    deep2 = uncond = None
    for i, (sigma, sigma_next) in enumerate(zip(sigmas[:-1], sigmas[1:])):
        fresh_u, fresh_d = i % k_reuse == 0, i % n_deep == 0
        if n_deep == 1:                          # exact path, or the CFG cache
            if fresh_u:
                uncond, cond = pair(latents, sigma)
            else:
                cond = cond_half(latents, sigma)
        elif k_reuse == 1:                       # DeepCache alone
            if fresh_d:
                uncond, cond, deep2 = pair(latents, sigma, return_deep=True, **deep_kw)
            else:
                uncond, cond = pair(latents, sigma, cached_deep=deep2, **deep_kw)
        elif fresh_u:     # both: an uncond refresh runs the full pair, on the interval or not
            uncond, cond, deep2 = pair(latents, sigma, return_deep=True, **deep_kw)
        elif fresh_d:
            cond, deep_c = cond_half(latents, sigma, return_deep=True, **deep_kw)
            deep2 = _cfg_stack(_cfg_unstack(deep2)[0], deep_c)
        else:
            cond = cond_half(latents, sigma, cached_deep=_cfg_unstack(deep2)[1], **deep_kw)
        model_out = uncond + guidance * (cond - uncond)
        denoised = scheduler.denoised(model_out, latents, sigma)
        latents = scheduler.step(latents, denoised, sigma, sigma_next)
    video = decode_latents_chunked(models, latents, cfg.decode_chunk_size)
    return video.clamp(-1.0, 1.0)
