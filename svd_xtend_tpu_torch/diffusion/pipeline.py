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
The opt-in int8 W8A8 modes (``ops/quant.py``) are scoped as in JAX
(pipeline.py:191, 300-301, 453): ``unet_quant`` around every UNet call
(exact, cond-only, DeepCache and tracklet passes alike), ``vae_quant``
around the decode alone; the VAE encode and CLIP stay exact. The weight
codes of the quantised networks are made before the loop (``prepare_int8``).

Tracklet2Video (pipeline.py:291-297, 355-356, 430-431 in the JAX package):
with a tracklet UNet (``SVDModels.with_tracklet``), ``boxes`` (B, F, N, 4)
and ``box_mask`` (B, F, N; all ones when not given) condition the cond
half; the uncond half of every stacked pair gets zero boxes and a zero
mask (the null tokens); a cond-only pass gets the boxes alone.

Tensor parallelism (the 'model' mesh axis): ``SVDModels.create(...,
tp=)`` builds the UNet for a model rank's part (``parallel/tensor.py``;
seeded weights are made whole and sliced, so every rank holds its part of
the one-rank weights); ``generate`` then runs as it does, the collectives
inside the UNet's modules, and every model rank returns the same video.

Randomness: ``generate`` takes a ``torch.Generator``; ``image_noise`` and
``latent_noise`` may be given explicitly instead (the tests feed the JAX
draws through them). Weights come from ``io/convert.state_dict_from_jax`` or
from ``init_random_``'s seeded flax-law initialisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import (CLIPVisionConfig, PipelineConfig, SchedulerConfig,
                           UNetConfig, VAEConfig)
from ..io.convert import load_unet_state
from ..models.clip import CLIPVisionModelWithProjection, preprocess_for_clip
from ..models.unet import UNetSpatioTemporalConditionModel
from ..models.vae import AutoencoderKLTemporalDecoder
from ..ops import quant
from ..parallel.frames import FrameShard, broadcast_from, gather_frames
from ..parallel.tensor import TensorShard, shard_state_dict
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
    unit norm scales, normal(0.02) CLIP class/position embeddings and
    tracklet null token, the tracklet instance embedding normal with
    variance 1/dim; ``mix_factor`` and the tracklet gates keep their
    constructor values. In place; returns module."""
    for name, p in module.named_parameters():
        if name.endswith(("mix_factor", "alpha_attn", "alpha_dense")):
            continue                    # the constructor's value (the tracklet gates')
        if name.endswith(("class_embedding", "position_embedding.weight", "null_token")):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("instance_embedding.weight"):
            # flax nn.Embed: variance scaling 1.0, fan-in = features, normal
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
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
               generator: Optional[torch.Generator] = None,
               tp: Optional[TensorShard] = None) -> "SVDModels":
        """Build the networks on `device` (by default the card: without one
        this raises; pass ``device="cpu"`` to build on the CPU); with a
        generator, initialise them (in f32, on the device) from it, then cast
        to `dtype`. With `tp` (``parallel.World.tensor_shard``) the UNet is
        built for that model rank; seeded, it is initialised whole (the same
        draws as one rank's) and sliced."""
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
            if tp is not None and build is UNetSpatioTemporalConditionModel:
                net = _sharded_unet(net, tp)
            nets.append(net.to(dtype).eval().requires_grad_(False))
        return cls(*nets, EulerDiscreteScheduler(scheduler_config))

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @property
    def tp(self) -> Optional[TensorShard]:
        """The UNet's model rank (None without a 'model' axis)."""
        return self.unet.tp

    def load_unet_whole(self, sd) -> None:
        """Load a whole UNet state dict (strict), sliced for this UNet's
        model rank."""
        self.unet.load_state_dict(shard_state_dict(sd, self.tp, self.unet.config), strict=True)

    def with_tracklet(self, dim: int, heads: Optional[int] = None,
                      gate_init: Optional[float] = None,
                      generator: Optional[torch.Generator] = None) -> "SVDModels":
        """These networks with the Tracklet2Video branch in the UNet (the
        one spelling every entry point uses, as in the JAX package): a new
        UNet of the same device and dtype holding this UNet's weights, its
        branch initialised from `generator` (seed 0 when not given) with the
        flax laws; the VAE and CLIP are shared."""
        kw = {"tracklet_dim": dim}
        if heads is not None:
            kw["tracklet_heads"] = heads
        if gate_init is not None:
            kw["tracklet_gate_init"] = gate_init
        cfg = dataclasses.replace(self.unet.config, **kw)
        device = self.unet.conv_in.weight.device
        with torch.device(device):
            unet = UNetSpatioTemporalConditionModel(cfg)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        init_random_(unet, generator)
        if self.tp is not None:
            # the branch's draws are the whole UNet's (made whole, as one
            # rank does), the branch replicated; the rest is this rank's
            unet = _sharded_unet(unet, self.tp)
        load_unet_state(unet, self.unet.state_dict())
        unet = unet.to(self.dtype).eval().requires_grad_(False)
        return dataclasses.replace(self, unet=unet)

    def check_resolution(self, height: int, width: int) -> None:
        ds = self.vae.config.downsample_factor
        unet_div = ds * 2 ** (len(self.unet.config.block_out_channels) - 1)
        if height % unet_div or width % unet_div:
            raise ValueError(f"height/width must be divisible by {unet_div} "
                             f"(VAE {ds}x downsample x UNet levels); got {width}x{height}")


def _sharded_unet(whole: UNetSpatioTemporalConditionModel,
                  tp: TensorShard) -> UNetSpatioTemporalConditionModel:
    """A UNet of `whole`'s config on its device, built for the model rank
    `tp` and holding its part of `whole`'s weights."""
    with torch.device(whole.conv_in.weight.device):
        unet = UNetSpatioTemporalConditionModel(whole.config, tp=tp)
    unet.load_state_dict(shard_state_dict(whole.state_dict(), tp, whole.config), strict=True)
    return unet.to(whole.conv_in.weight.dtype)


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


def prepare_int8(module: nn.Module) -> int:
    """Make the int8 weight codes of every quantisable site of `module`
    (Conv3x3, QLinear) now, outside the sampler's loop; they are cached per
    parameter version. Returns their bytes."""
    total = 0
    for m in module.modules():
        if hasattr(m, "int8_codes"):
            codes, scales = m.int8_codes()
            total += codes.numel() + 4 * scales.numel()
    return total


@torch.no_grad()
def decode_latents_chunked(models: SVDModels, latents: torch.Tensor,
                           decode_chunk_size: int,
                           shard: Optional[FrameShard] = None) -> torch.Tensor:
    """(B, F, h, w, 4) scaled latents -> (B, F, H, W, 3) f32 pixels, decoded
    `decode_chunk_size` frames at a time. Chunks hold only real frames (the
    last may be shorter): the decoder's frame convs mix frames in a chunk.
    With a frames `shard`, `latents` hold this rank's frames: they are
    gathered, chunk i (the one-rank chunks, whose bounds are not the
    shards') is decoded by rank i mod n of the frames group and sent to the
    others, and every rank returns the whole video."""
    if shard is not None:
        latents = gather_frames(latents, shard)
    z = latents / models.vae.config.scaling_factor
    b, f, h, w, _ = z.shape
    cap = min(decode_chunk_size, f)
    starts = list(range(0, f, cap))
    mine = lambda i: shard is None or i % shard.size == shard.index
    parts = [models.vae.decode(z[:, s:s + cap].to(models.dtype)).float() if mine(i) else None
             for i, s in enumerate(starts)]
    if shard is not None:
        ds, out_c = models.vae.config.downsample_factor, models.vae.config.out_channels
        for i, s in enumerate(starts):
            n = min(cap, f - s)
            held = parts[i] if mine(i) else torch.empty(
                (b, n, h * ds, w * ds, out_c), dtype=torch.float32, device=z.device)
            parts[i] = broadcast_from(held, i % shard.size, shard)
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
             latent_noise: Optional[torch.Tensor] = None,
             boxes: Optional[torch.Tensor] = None,
             box_mask: Optional[torch.Tensor] = None,
             shard: Optional[FrameShard] = None,
             amax_groups: Tuple[Optional[object], Optional[object]] = (None, None)
             ) -> torch.Tensor:
    """img2vid: (B, H, W, 3) image in [-1, 1] -> (B, F, H, W, 3) f32 video
    in [-1, 1]. `image_noise` (B, H, W, 3) and `latent_noise`
    (B, F, H/8, W/8, latent) are unit normals; those not given are drawn
    from `generator`. `boxes` (B, F, N, 4) in [0, 1] and `box_mask`
    (B, F, N) condition a tracklet UNet.

    With a frames `shard` (``parallel.World.frame_shard``; every rank of
    the frames group calls it with the same arguments), the latents, the
    per-frame guidance and the UNet's frames are this rank's of the
    video's (F / n, or an uneven split) (the noise is drawn, or given, for all F); CLIP and the image
    encode run whole on every rank (the image has no frame axis), and every
    rank returns the whole video (``decode_latents_chunked``). Under int8
    the activation amaxes of the UNet and of the decoder are the largest
    over the process groups `amax_groups` (``parallel.World.amax_groups``:
    the ranks that hold parts of the same global tensors)."""
    cfg = config
    for mode in (cfg.unet_quant, cfg.vae_quant):
        if mode not in quant.MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
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

    guidance = torch.linspace(cfg.min_guidance_scale, cfg.max_guidance_scale, f,
                              dtype=torch.float32, device=device).reshape(1, f, 1, 1, 1)
    if shard is not None:
        latent_noise, guidance = shard.own(latent_noise), shard.own(guidance)
        f = shard.count
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
    k_reuse = max(1, cfg.uncond_reuse_interval)
    n_deep = max(1, cfg.deep_cache_interval)
    deep_kw = dict(cache_depth=cfg.deep_cache_depth)
    box_pair = box_cond = {}
    if boxes is not None:
        if box_mask is None:
            box_mask = torch.ones(boxes.shape[:3], device=boxes.device)
        box_cond = dict(boxes=boxes, box_mask=box_mask)
        box_pair = dict(boxes=_cfg_stack(torch.zeros_like(boxes), boxes),
                        box_mask=_cfg_stack(torch.zeros_like(box_mask), box_mask))

    if cfg.unet_quant is not None:
        prepare_int8(models.unet)
    if cfg.vae_quant is not None:
        prepare_int8(models.vae.decoder)

    def unet_out(x_in, t, ehs_, ids_, **kw):
        with quant.quantized(cfg.unet_quant, amax_groups[0]):
            out = models.unet(x_in.to(models.dtype), t, ehs_, ids_, shard=shard, **kw)
        if isinstance(out, tuple):               # return_deep: (out, deep)
            return out[0].float(), out[1]
        return out.float()

    def pair(latents, sigma, **kw):
        """The stacked (uncond, cond) batch of 2b: (uncond, cond[, deep2])."""
        x_in = scheduler.scale_model_input(_cfg_stack(latents, latents), sigma)
        x_in = torch.cat([x_in, cond_lat2], dim=-1)
        t = scheduler.timestep(sigma).to(device).expand(2 * b)
        out = unet_out(x_in, t, ehs, add_ids2, **box_pair, **kw)
        if isinstance(out, tuple):
            return (*_cfg_unstack(out[0]), out[1])
        return _cfg_unstack(out)

    def cond_half(latents, sigma, **kw):
        """The cond branch alone, batch b: cond[, deep]."""
        x_in = torch.cat([scheduler.scale_model_input(latents, sigma), cond_lat], dim=-1)
        t = scheduler.timestep(sigma).to(device).expand(b)
        return unet_out(x_in, t, image_embeds, add_ids, **box_cond, **kw)

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
    with quant.quantized(cfg.vae_quant, amax_groups[1]):
        video = decode_latents_chunked(models, latents, cfg.decode_chunk_size, shard)
    return video.clamp(-1.0, 1.0)


def generate_frames_uint8(models: SVDModels, image: torch.Tensor,
                          config: PipelineConfig = PipelineConfig(), **kw) -> List[np.ndarray]:
    """``generate`` (its keyword arguments as there) as host frames for
    export (io/media.py): the (H, W, 3) uint8 frames of row 0,
    ((v + 1) / 2).clip(0, 1) · 255 in f32 numpy, truncated, as the JAX
    package's ``generate_frames_uint8`` computes them."""
    video = generate(models, image, config, **kw)[0].float().cpu().numpy()
    return list((((video + 1.0) / 2.0).clip(0, 1) * 255).astype(np.uint8))
